"""IQ-quant grid codebooks (format-specification data; a copy of
tpullama/gguf/_iq_grids.py).

Extracted from the reference ggml-common.h tables (iq2xxs_grid etc.)
by scripts/gen_iq_grids.py — these constants define the IQ bitstream
formats; they are data, not code."""

import base64
import zlib

import numpy as np

_raw_iq2xxs_grid = (
    "c-n<kTax4;4EyB@I)m<izZopam@Ku^)hQBU{E%d4E&b>fxHsq(3r_=n4Cxii2fhcX6~8yy=H-xCn"
    "P)kKudid^6CjRxJ3be4Uyd=Ij{w*fwZ|(U6PT%t@DbVv?Z?mLOpr;GNtoJ4m9ot-k-`QDN`o)tej"
    "n*Lv*5(&E5S(@p%SYKIy*X>36x`(0gsC^8_;}#jPvu7Phf$+02af7WdcrFAV9wXmU|mL0Oy8z0G="
    "z6I`xH%fQmGT5JzQP%B#qOknWbK9FYt$rBAPt%_L-M_eiXvJVaHog6j~66{xATlr{-<N9>m(b}Oo"
    "p{fB5{5%F~Fb#(!(=784>9f9B@6z3ZGn+3q@y5w7NMpY%0OHh0Z3zQ<Fp}HFai&FZ;r^6-6(dkM+"
    "dDHD`JHdFt**(`9zu`FoW`wM6iK>gf<6bzzq4!#b0$*AH=425hj$4AKAuntsz5g`=c{PM$QGaO~v"
    "q6ANtO33ng?jEuHa|Q0oOA+FY%`KxT;0`cj>=}tlF^Wz8ss$rdn_0Q&s{ou`ooeoW=4@_)T1%oYt"
    "g!=rlGBUddA1N7%=TppnyWya#s6Pe|25{Va|Z|)S)EkDqE31?*x|A"
)
IQ2XXS_GRID = np.frombuffer(zlib.decompress(base64.b85decode(_raw_iq2xxs_grid)), dtype="<u8").copy()

_raw_iq2xs_grid = (
    "c-nPW(Us&d2>W#lszLqtHxrOBIPvbwahpkO5R&k$l|NJj<_#)hVLU)ZaK1oAU@m~A1+)+q|BsD@s"
    "R+!Cu=u$l75`6-1h6m?`M)+2f-WaU#pkJ>C>5V{dg4^X;%6aLd|vB?Vd1+#QlG2POToULhdTgR_y"
    "ht=KpcQP+jl_z|Bwxn)syie4KON36%D}H{R2oU28<0@EDV5o0PU@AKpP8R1|AEa4RFe5Bak~+LtN"
    "6?kcURSF?53vl&D6zH_piy6%ESS$mj|;l&{9}WICDaW;FD-#;b%CWei1d5aGWKbw478icy$=lQ3="
    ";FbRag#!V!b3QS^QbZZlgBs!&Tgfn!&B%ps!BKppYkVQm9q@v$+%DfVlgRpL;xoHkKgOkY4$i>8B"
    "o!F7iCb%=d61@l>wZwXCm7c`sDFDQa`B4*sQy~f=ghxK~X~Hmdo$~73E4O_M$4Fm=ldP={Tm{68z"
    "!Z{yPeHkpr?5bN3M>(dHzOheDJC#6dM*wDb`$0{i)dPY&dkgL4TWm5QIAtt?h5ixy~WMMHHV9bK?"
    "&TIV~*cq@F{#FggF+WEsOD|F+lE#ImTW_;hUIarj&CU2<8}g841MZ?8sK!X)IL4wAV5kqk(C2rCe"
    "u$X<L=s-H@izUj~IC_eX18#z_gS-3<&=X0HhgsCP)2uuNdpmgpHK-9zlUzZ%U-8JP5`)L%wO4hOp"
    "#BPPrRcCNe)lIICP$T8JW&UhLp<~GUKEMtqZ8!M|y>Tja`XJvzs6Ra6AeCWyHVq->{ggjLBQ1yH)"
    "bTx40PM==V1U228v4>}cmFQ>?j4zj<4Zg^n+Kmd3j05&rHcUSfq{z8)b^~%gJu|;%_-jQC3Kw<`3"
    "?EKh@NIC|S#6Gbu>i6Hco{GoKpX>yWAL!{>aM#1J_nOFuFh}w&@m&2&mLS-WC|^3Zy-$fv<BHq$~"
    "lXCdesE+sM9d933|LNf09v5p^z&=+y<ixV%eu`GRvvcMlmDz-UHN3FNd*=Q!7c(ydO(YG1)1LV=y"
    "i#mSRUqaOp$Sj%$znMyqNqIa{nY)QYiMJ3*Ult4P4}WWB#?p$R0C%$!3R?nFP_vn`>CURR=@N6|c"
    "T5pD46u{x3Y=LhfRKE4"
)
IQ2XS_GRID = np.frombuffer(zlib.decompress(base64.b85decode(_raw_iq2xs_grid)), dtype="<u8").copy()

_raw_iq2s_grid = (
    "c-n=TVRqy&2!sFn3OWP#zh4`h4<lyM?!G*>+eu=Bkc4Ng^CvP&{vVN1OZI`tsPG#iqvQ|J$_M0wB"
    "IEDJ?7@*y@)v1^y)ZH=d;yX1_bywImcB0R_s4Tz<j;Ar;K=yg)i)3spJnz9X~ox#MaJjjeWO~k4M"
    "#?WCqT+XME<-oAtN!7QOdaDYofTGhxNp1>1zU?^hBnmCp0oX+wBQ{w$T&)JnlTl6Cdj&UOoA2j+e"
    "E9M8=(+R-nDwR;b9h-_i;f8F$%QAtR%ftgw-Br@s|CGVV0Dr2&A*sBl2+w48P4RwC~U0}Qp{0zi>"
    "bO9rUOxR=uawqK`{c(v34yvVpe)_@opB?qQfd<AG^loGI!KQDa+Fr}l`TnY!a<N%i(=vs2XCo}9+"
    "{m}qmp4@T)lGQgA`SR8%8{KjGBB7_=K#_4*xiwT|+}VuGUgT~gci9?m|2DF%B6+GoeKurd+^}s8y"
    "5ZOwbi*YQCXsNk#trpW+6!w9ttD&hSYZtwqtTzcdn+y@FV!BFv8W2HfJMea%EeuRpcIl5h7A3n7<"
    "67DiPcdBiY|35tJWnP$%#jqrAa_QL~=qRr~HMWBIBW%OIVTd(8(n*?j!|~@zB5}w#aze`w|^*oP-"
    "CYPdi=$WMvQ`D<t(`lA0da-yKYXJg~hxgD~0Q8)4F7a3VcSMph>$NTd-fO##7@!PPfii@U@d8BZE"
    "75tI2z$WQ>co;2JFO~R&Pt8pQ{-HDvsazX4=dJ;So#L^*r5HX1#guDp=TZc12(i8-c^(G7tzjfr%"
    "nxSSknsBgJE|9u<lg2H{PE<qk6__w&7Zo&0Rx2r*KnF}=q9dk2Jt}mb7k>)XliV&?NCHqoi|Dx3M"
    "Ymkw6*kB|(sj|HQ}6&KpqRpU)aMFdqyW<4QwZtx!s2p4MB=I?mc9xkmg-F?OM~+7S!kqhjg*)!r1"
    "^>3()lDz1ht2nxov_=PhnaR`?~HMFZnishD@eVpX7JJc4rMmPy(283OdX=g*|rLUV+DoUZIx>zBX"
    "L1@E0|$W=0z`Ph)VCe13qrOB#1N;&ey%4qz4Ia38Uwd@N-QW#}k_K}F?bB)wJ2vE1a85djJE@ec7"
    "R#aT{@kXjiRkW^&g<5n3OibXL<W+ltVqLKz$Pd>(=;&V(vbyZmLv7)F>J~kBc<>Npp>oin!2y6?x"
    "%I$j@Ex8S^t<ho9Fkmt}T+&Dv$?a_!G`Wo}g9aMpcC(-=x09u1a+_G4FSmo0<K?!lT6wu$!=9B9l"
    "-sT{gfPpnSJO_FQIy-Gk}$dbDW;O!n&RwfEUAIqe$*qT;oNH9oYR{Dg(2lKUrU<CR4&i01vb#Ox^"
    "`zqCgt*2jEqOZL*V45!3BFm?xwum6M`2b4D-w7rBYtS$wkWL;NzqrX?)W6tD#15<TP2OUQTn9)=F"
    "#TG*(=)oR%gH)t2P+Ql@PhcoY%yfVGg*K#}$Gwk?ua-i`%YKqhaiN(L{Hw?|!bK#;@tV^EO8tXgR"
    "f4suvj?jC{bgM_?%Wl7~_Dd@=4U7l<X9<ZD|J+<dKkjS_5F_?fF`D=?h=D;HV^~d1CKjr`vTaiBp"
    "8JrO}VnKPp9CUc#9C*$!b4@uf`fmW*uJ*h?`ar}2mz{p!0f|;;;mkB_U=B`f2rgn{?*o;e%wbYU0"
    "HRDH=D<Z_-Ucu2EqxupnrqF3w84zTG7^yBIjE8Fw}Fj9ybW$xREh+pRy9t?RUu1h(%NwEPF)-Hww"
    "I0LNqWJTfBnMOEj0)N1So^0Fsl`kmwjDPgCg7jV8ALh;hF$KApsIfiMd*SoL)eqv;eNe%a64Sh>#"
    "qBr0KZ|Tv_BJ=XX%0L-TmHfDEMq=u+_15CFdVNZtUyx@5Kn0J1c~@?*Vf3^bnxDK5+<vbQ@Z`w22"
    "?N<*P`G*(GOZk0xR8>}OnisH{fTc_JT2JS-5vSWj4+}drfl1Y$;F2|E*VUu7R7Y~OX4)i1CFap3a"
    "F}^Jy&x#=426-k?h=Y|uAal?Mb8iFxBpRd{!kL4A+TS9gw*vr}V)ZXAul=e_LSXZt0782^FgS++m"
    "+<~OK!6A#n>d@_wAhJp9x%j7WzD!c)vVz=S5YSdNsDy=0m1UEEp%4jQs$Qs5br#wC@39fD06yJ8T"
    "UI$jvQ7$C5k*H;^uj}asLUyza4lSq{Y3mtR*FxhNv%J>x}BWUT1{K9<3v+`k1e_EiFHme|`Xg$d1"
    "G"
)
IQ2S_GRID = np.frombuffer(zlib.decompress(base64.b85decode(_raw_iq2s_grid)), dtype="<u8").copy()

_raw_iq3xxs_grid = (
    "c-lpiF%Cm92tyY}Mn*<PMrQ7RtUi-3^+#6HGy!8AGqV5%+|3fKzs&%i%>0>a*1#DFbU1*ATgST?z"
    "{{=rA4H>o`wJMrGc3UZZ)VUN7kPn_2IyeDN$6rKt77hgOL4w9-<)sqf^O>^s~PUE6&R4U=Cj8*AA"
    "M049nrXANaF>*kXM`->r;^tZy{E?t)WdzR{M&NPXN#KDKM;I(ZCu+dx1e5-)4UZfk^d)k~;n*Jkc"
    "c8#7m0)msnJxcVdcxhEgY?7NGfwtm}T!pWyn?nnnaNJ>sgq{57FKXCWg%^$j{&&AvLj>}{ZBbiHE"
    "jDt|?*m1ved?0wCPuYnpxk^w4>%~Kl+Bn0~e(?_FdYq3Wsu9FSp&Tg3bq(&lYCWaWf;gqXRW`G5t"
    "i$xZ*#Fd0$zyy}yHwn6+!x3+sG)0Bl=`$5hDmftJg4Ap@>@yfH9U&Y#-1cMtgral}90cLQ#)RFHq"
    "uW!a98}#Cv%<(~GoVHW@X?@8{0<bn3P<d8k!HQ3ZLh<64Uk!$p$z>R14DS7;pIjp6EnS72&@FNNm"
    "59ex>u~%h8K}!_6NkMWBC"
)
IQ3XXS_GRID = np.frombuffer(zlib.decompress(base64.b85decode(_raw_iq3xxs_grid)), dtype="<u4").copy()

_raw_iq3s_grid = (
    "c-lpki;BfC2t)}YA|n3(-|iXhaw$XFH1##3eeXR34hqb>4Fe7m^mo8Ofe4<HEl^;9@o~sNvkweI3"
    "Fb4X%Rzp|4b<l(zyJ&OK;qPJTEOR=>+1sZ1rnfvIs2}l{3Y<@84NIj4Fx=`0+(6fmjpbX10$IL4K"
    "mp;_Q5pohO=|YhUFVzB%Q#6q?3JMUl9~xs)|mepg~X+%Oa-Y2z$-muyUC-c3GqOgmrouP?jksoO{"
    "q9g6CqtuAp{wSboK|E1wmZuh^7D=^AO7(!ssqUTzJOON8AKZLO6A=G+JSaT_AaMb>a`jx=2b1`wn"
    "ra1ohq0jjuf_U4SKf@HB#>f*2sATi?OIbpPU9^RrlDv9OX3xmYMGs0+zqu8wrOc{q=fRK$@?u&bG"
    "VrqP_X7gQd0x-K3Qse|@6|BiKi6Pb%o2@#;q8K>wDa%}|N}l%sNl8?a5uvUmyiNw9-=T8_3w2(fa"
    "7D}8?B$(jtd)vM`YM6vS6EEsvab`k0BGDNuGr|>2aurWTm$GpshceJixeRdj=niW#1-CsB%!2j7M"
    "&t+BoArHJ&jW%g%cGGL?Za4iL&s?I%=rKSFbWDoL8~7)Go5AxL?BsfuY$A&X#F0#2dR{?OHErH^S"
    "Ifijh#%HvJQfx)j-llwh0DN`$5*Q7G-XhL!@whAz^jc~4+()r0%3L@2WLEa7nwpLA()KME&TjHqU"
    "dX0lXtP-i62ghF%pDyqUt^qCbc1H($ES)P#58u84shR$}7XljT6)IhbLDg+5+lRG-p_L^Lb&TYjF"
    "MvSY4N)f9eihCeQhNdvmK{6@zMBIRaCgjik_)aM`k&=;0MYu{r#5=?k3ZLYN0d8$_C)TLZNZy+Qs"
    "Pm$e0fs*&na#2V$Hb#)OZ3~BJC1h{VvRREW32lOs$o^Y(sZ^}x>zc;qFPRk9KJFxq`F1c6rZ;eKu"
    "v*NWW*Z|sI1sz8URXxtt=ufO&}?gMJK67uXs}ergPAvNNPTAyYb(9F(T>aM#&l(D{vIhswP%i7d7"
    "P^#Xx#!s*y~~0p;Uu@{Y&=VPdgbQ~zZ%fcUF?Lq6}<xWk@$>36e3U%!d<pdrNvhy_}Vz%|xgf0@z"
    "rZjBF(2X#RGH=Gn0D>iDvUj|AgC0{D>L;3iD(7W3;3gHjgFfq*"
)
IQ3S_GRID = np.frombuffer(zlib.decompress(base64.b85decode(_raw_iq3s_grid)), dtype="<u4").copy()

_raw_iq1s_grid = (
    "c-nPai&i8{2qXXh(d;^v1j6W^>&4cdepEpS0lVKn&{pLSKwDk>eV%}GB4~>rC|!{s1Z@@KLO2%$?"
    "f=u`1~@l@Z}|D|bGPF2)_M@o{@nI+O#5^B;>X{4&;I=QbIb>?dKP?v`dsl{@O_TQ0MBpmIj~<CwE"
    "s;k0M0^y_UCSUVQ>}*v_G#0t~dBt;Pbs>#6sdMC}@8!!~25Qi3P`5c+l3_0MLG(g5Q4r2ikfYg0n"
    "Ft`_6oi|9*~r3vHOb;O{Fo611O>FHiiO_W6C=Bi|!eY<ST^$EfgR&{iQF1hlgh&q1ovVL)4U9Pqq"
    "np<|?D{VWr>uD>}NXseFneQx~x7w`J-7_^@Up&u+q{rJIhSRBWdQ*lvz5{^TI_Ot6CK7gwUKK*id"
    "9LERk2NzZ#-~<F{-`WumR-k;`3=DJ-2QV%x<SE(GF(SY|+XF5?xcuO9zx#mKj{w98M16ghVFe~mf"
    "P%IdsP!V_Jr17_T*n=_TKdoBS0DrWc|~C31UMAvfv)9XloK8la_C=xs2d&O%_Z-p7i#wgP`v6LtK"
    "g^WxN6x4^z5L0F!TUq|3*OdV5c5lyt@goYF`1g0=A-sj!}_`9t<!L-{-;4@kyAW3h`twTweA8*BQ"
    ")o;Ke}n1fL6h9&o)uwAla)+UI`r<^o>OJ~x@%N{n!9^#<1k%mNn%c{3=uO<dgKVmu644>LO;fG=9"
    ";7(6EMzh&GBpuy)vWcYfvXg?2DjOGW1*gLO8QnGkfxmu5?SeA!qP4oqQ5B{DW1bI>+5)_ag*0Tgv"
    "T(|9cI0>w1p<^aAAU#zHu4tiSWa1NK_iRBVL?|)Z^D7c%(L%@IF*1>Y_T|HgAVCLnbHm4s4SqHFJ"
    "?-<5=YN~QK}>F3i3ys&r*-5qkwXa`{JE?W{Cly7$1C9%Eo4am09q1(sw4nE1`D(Fj`fm`5k=sKTA"
    "+X-5OSK1o0B+UJ}jaE+5)XY?GsUqBQP!&AwiFi7l>*b@d`X|Aiq`!i^vEWMQDl^ItGuCgs0wyJU#"
    "|KEuWju2VO4-5k2woulL>%XTb8Q&jmq$S}99QRY)QQ+A0z&@c7;7-JTyNbb%QFyzjGkwxbFgVkQn"
    "DZ0V>T!2CSKO{9RVd_Y)1(3@2b!NVbXVq=dj4e=A3d3kz>pxA~Xx+h0WR#X-fr5oZ%ls4*hpvGiM"
    "MLDCE(FsNa3Ejhn<rSD+JA_nkMMN=nYmIRTD`=g9n7KhB`{*P{A77^4OA6YTm%;jM2rmxt1+7w@h"
    "%m8)`IvsN2y#tG4~eLGawY?UEy2n`h1rxttY1C_^C<mbpQ4<ny#|7aD@Dt-#Arm!OZEYRSN5eBFr"
    "9!)unGLLMf)5Bgy~^QBKn|xa6FWO%$puZOyl}uGc7Geu|P2MqJ;{EM?DzouHYXmOd)|&P^eZAcj#"
    "R-twKZO-_)iTX#wMW6(TqV2~J^xQ=ovBOJ_!@!iAXXy;kawYskajwhjYTp#$2t9gO3pSbzo4tG~E"
    "^U_7tF2&X{OEA)!lT`1|x)Q^l9ETG<FF^*S3g;Q8*iQdPi(84LWKx^%yx9Vhh%rcfDzEY;DKV&H;"
    "y(!pS#dgR))luzDiG?Hc9C_zdIjUw<#eB;<6>QzIjVp>ySw?b<<d>4{QYouQK5<3Tzso2_MzM`%R"
    "?lp2nd8bB=8}{rEI$Zog<3~8kUa39XBD(8%gbVFWqE87Aj{WVw)%`yj=JI!;-B)fL_S0ckY%U0T%"
    "a#-?hPudY&_+nOCv!;Ww}?UyfZfxS5a<IOx7vPPnqRZ(^)=wWlnkI0^Vg&M>$icd~ulq7y40_sQm"
    "CNopQqELuHwuGJr&O$^c89w+u*{?^@sw`YzgTB~}ty9lG90&r9_D&~VXiGlNQ6J(ami0?6Zn9$)%"
    "fq`gxz%N0adMN`QY&_N#!J(cuOG|(P?>7PsUq;Fre&B;q(eCQSk23EL}R=HL?G-~M6p-W1k3WY<D"
    "E-exrvJgZ%B>GdLJ)$?4#vJ-m)HzLGq?nMd6zR&VT2?LHzte!5?w#J5iIl#LC`_L>J)SPpSDLiQu"
    "iC7#i=ys_Mb65!WvJ;)M|IMVi&mu#ob(_PYe6hjV5zv11_b}TwdwCPU=XcP8%JQPBecnBjtXelu7"
    "u}0aBLs!gk8I8C%j%btplG{$U5P%4jc;ZMgr@Ar#f&X7#jE?%;3O^tKAN`_zMo4;}y=LvULQ;6Na"
    "un7+wl1v+({sJnDqQ%7EeCPIaAbYWM75J8r_bw(8&A&l$GTos2!lZR`V`Zct~t>uj&L6}i22w$oY"
    "T3aKh3Dz~G~^512zujMA%XjzfVTXmMPa=Gd(k3*vJwd=f&lU3(q`*ABDtIqAcOXu=->N-Mk<&XVo"
    "{lgKG^#dR~r8=Q2Ps9<P^+B8qbe#)<QXf*Nt|M6MMmPfYy>VAQ0M3I*=%$j$N}Y6r`@DtlLOys`z"
    "CbUnatr0PG$1j@{le6#EvWys0ODS~ay{rCTX?U9JsWzpa5%!e77}McyUxN=xR=sWBgKZ0PsxaU?|"
    "UP_jX)zd1hftQoK_8i+CA>IVQLiAX%uMVUadVF*Sp!ZHnJ->6sOTpr{MsJ^OYNq&JFLOV6pLiHy+"
    "thk%A>hkTg=Kfl<4t*p5=^7+vWgIF8aAtQTeMN(aJejOYu;vAWX1a2>7PdXi&><8`G2>JrrN-_de"
    "R&zc+ug?b;yLGg#9sxectUE#obg<kKxl|vy7g}g_L*T@Ly_@dwn0G|3(E-+3aAbL$N!9ylDAlx|W"
    "ionp4cTAm3z;sNDV44?CIkR|5ec$3!uUV7n+LLAe5_ncn>yJRh?*WM$nA;h&XsZ$i0~9wvdv{^nZ"
    "E@+Y?t!`m9jZE9^VV`%Y)rU;-CNCEfgbAE1iE{QsOVg3*hE0kOIzB&(5sf(K+%<efdd>6meCi`2t"
    "a9Po?R7>q^8obqZ)O!>8;2r5v~#~u0|C#vo06FaDc2U0SpJoI#}3n%nI`G4RBovbU1(qIps*wzXB"
    "i*5JI*Qz(~|^LsK0Dw=T+)UG#o>Wq8?WzjYd+lFYS=T?w@LR`65x0p6$cfQ@{R7fg#EuoA>GD;lm"
    "^f^I|u7P8PWfgR-@k2GHoZ!EwU_PXhf!%$8`S5GPt-6D3+OvFwMy?QtnFIEHCqkVq!Yz(XT=}oFJ"
    "sZ6fWC&4%=5WLk;#vh5NhiPRZ>NS%<u@Fl`mlCH0)m@ROdR=NOc4lzU4z@~e@N?kjuy?p~4B3rto"
    "Q5|}<6FHKF~l?8>&Cc-O>V;M9K&_vTrHzI4RoAFx|%v>puI%v8GEHDs;R6=%o1nRV(c7Ob>c?F7^"
    ")L_=XmLNLPs|A6+t(_caC?u1+JEvm~`iOrhA6!eMzg4GCPC;F(`mDFrb!PoxuT|0Ro&s0uzpoaX)"
    "nrOg!ZBXAI9VBnilbq(iN9lS2f>qIFGAa*c<<s!PSVmo==;F)bsPpdE+k2va-A;7s;(jz4Ma$*n3"
    "S+d6|00t+pU5Yyv8Vl^FOJ|<Miv7RAVIgaB?I%_Bk=$YBFAZiJ9JRz*8?;K-siQPGt;vTlVhrPxj"
    "cwI5j@kRLF-Hi!210QM`tHSFX-|!h~_SSAHu9i&S@d{OlJ-s)6Zp6bi8I2yz#KrU?qHRvn*d>oC1"
    "IG<I#|r#L3PKUt&anU=sMl?xo9%s<Se@;6uav$-j62)sUP-mfJ<`|F_BK^F^-%@g(U$%q+@0-X6K"
    "`Aso^4(ajr>K-JExmX)HR4xXAnoJSE1Is$+8H&niwMXo$XJHi4{|wLj|=};;5Z%LzD8#_MRvEI;Y"
    "oQ5}>5iF|{?+lTO+DBCBxdY<IbUP-KX4-2$SsjRXq0{!@w0Hjrn`RcI*U+@0@ei@4X&+14<_>ug&"
    "%6;^azr%>r^Gx!}k+Xjw!59=TYrli<(%J=RXsUYf<;mtrz{To>*r5x_UsZ+)_gOyy}DL-3W@069z"
    "cso^FQ%t3jPMOyX*<81`DmMdRm9nVUv{HR?F>_>1Lsq3s2_Pp=P3k&S2^<*^_@glF)mz<@tmvph{"
    "V=zH)BqbF+=FbwddLc^QoeErSgf6TtN(UMtkSGetgbhEn%<_^kk||=WEpD!!xDPSDVETjrC8Z?$|"
    "3%nn@*X-g>EM*aY$ea;7%0rOqApXMRP~gO`+T=7r640S82EFl=(P?v^i&%<@QY#!!D;Q%Hc&05gm"
    "Dfvp`eerXcFCLOcubUNNyN$Ii0M%t7Ut%B{{a%FIG#lgp!ya>o*>-mtR_F*6ZIP|S9g5oRtb8<tQ"
    "oLr-fkQWdd=S0I}-e@0nq|Mi3ExGAktlLUxPx@>XBbodNl!h@J3{f~~CGIi3+C1?Z<9M2#mbkaIs"
    "Ok7LY*GbEKifEYsm{2sR_cYob01f(KhN$T#(~cazM<>0o@N&{LPMWshqO>blRu^4q@(M7WX~{~*6"
    "=akKR6Dmj09!<!2$QHO7#F6wSnq&GOC&Br2#cL?29ul)_`!i6f;D*K`ICY^!jN)+F@~iW_rzbF;c"
    "iBcGhmA|Xsd8k_1qaYMxajjcZDE#S1#^!TYt$-#pX3KVfSkMDr|{8Y5SG!wXLWWyt+4<j~InB2#h"
    "ljj58Rl$Cg0Wd3&!e&fu^<uG2ez?6dUmA2T@&4*"
)
IQ1S_GRID = np.frombuffer(zlib.decompress(base64.b85decode(_raw_iq1s_grid)), dtype="<u8").copy()

# ksigns/kmask are computable: ksigns[i] = i | (odd-parity(i) << 7)
KSIGNS_IQ2XS = np.array(
    [i | ((bin(i).count('1') & 1) << 7) for i in range(128)], dtype=np.uint8
)
KMASK_IQ2XS = np.array([1, 2, 4, 8, 16, 32, 64, 128], dtype=np.uint8)

