"""Built-in chat web UI served at `/`.

The reference's llama-server ships a SvelteKit SPA
(tools/server/webui/ — served from the root route, server.cpp webui
handler). This is the capability-parity analog: ONE dependency-free
HTML file covering the core loop — model info, a chat transcript,
streaming /v1/chat/completions (SSE), temperature/top-p/max-tokens
controls, stop/regenerate, and an API-key field for --api-key
deployments. No build step, no node_modules: the server stays
self-contained.
"""

INDEX_HTML = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>tpullama</title>
<style>
:root{--bg:#101418;--panel:#1a2026;--text:#e6e8ea;--dim:#8b949e;
--accent:#4f8cc9;--user:#24313f;--asst:#1d262e;color-scheme:dark}
*{box-sizing:border-box}
body{margin:0;font:15px/1.5 system-ui,sans-serif;background:var(--bg);
color:var(--text);display:flex;flex-direction:column;height:100vh}
header{display:flex;gap:12px;align-items:center;padding:10px 16px;
background:var(--panel);border-bottom:1px solid #2a313a}
header h1{font-size:15px;margin:0;font-weight:600}
header .model{color:var(--dim);font-size:13px}
#log{flex:1;overflow-y:auto;padding:16px;display:flex;
flex-direction:column;gap:10px}
.msg{max-width:72ch;padding:8px 12px;border-radius:8px;
white-space:pre-wrap;word-wrap:break-word}
.msg.user{background:var(--user);align-self:flex-end}
.msg.assistant{background:var(--asst);align-self:flex-start}
.msg .role{font-size:11px;color:var(--dim);margin-bottom:2px}
form{display:flex;gap:8px;padding:12px 16px;background:var(--panel)}
textarea{flex:1;resize:none;background:#0d1117;color:var(--text);
border:1px solid #2a313a;border-radius:6px;padding:8px;font:inherit}
button{background:var(--accent);border:0;color:#fff;border-radius:6px;
padding:0 16px;cursor:pointer;font:inherit}
button.alt{background:#39434e}
#cfg{display:flex;gap:10px;align-items:center;margin-left:auto;
font-size:12px;color:var(--dim)}
#cfg input{width:64px;background:#0d1117;color:var(--text);
border:1px solid #2a313a;border-radius:4px;padding:2px 5px}
#stats{font-size:11px;color:var(--dim);padding:0 16px 8px}
</style>
</head>
<body>
<header>
  <h1>tpullama</h1><span class="model" id="model">…</span>
  <div id="cfg">
    temp <input id="temp" value="0.8"> top-p <input id="topp" value="0.95">
    max <input id="maxtok" value="512"> key <input id="key" placeholder="api key">
  </div>
</header>
<div id="log"></div>
<div id="stats"></div>
<form id="f">
  <textarea id="in" rows="2" placeholder="Send a message… (Enter to send,
Shift-Enter for newline)"></textarea>
  <button type="submit" id="send">Send</button>
  <button type="button" class="alt" id="stop" disabled>Stop</button>
  <button type="button" class="alt" id="regen" disabled>Regen</button>
  <button type="button" class="alt" id="clear">Clear</button>
</form>
<script>
"use strict";
const $=id=>document.getElementById(id);
const log=$("log"), input=$("in");
let messages=[], controller=null, modelId="";
fetch("v1/models",{headers:hdrs()}).then(r=>r.json()).then(j=>{
  modelId=(j.data&&j.data[0]&&j.data[0].id)||"";
  $("model").textContent=modelId;}).catch(()=>{});
function hdrs(){
  const h={"Content-Type":"application/json"};
  const k=$("key").value.trim();
  if(k)h["Authorization"]="Bearer "+k;
  return h;}
function add(role,text){
  const d=document.createElement("div");
  d.className="msg "+role;
  d.innerHTML='<div class="role">'+role+'</div><div class="body"></div>';
  d.querySelector(".body").textContent=text;
  log.appendChild(d);log.scrollTop=log.scrollHeight;
  return d.querySelector(".body");}
async function send(){
  const text=input.value.trim();
  if(!text||controller)return;
  input.value="";
  messages.push({role:"user",content:text});
  add("user",text);
  await complete();}
async function complete(){
  const body={model:modelId,messages:messages,stream:true,
    temperature:parseFloat($("temp").value)||0,
    top_p:parseFloat($("topp").value)||1,
    max_tokens:parseInt($("maxtok").value)||512};
  const el=add("assistant","");
  controller=new AbortController();
  $("stop").disabled=false;$("send").disabled=true;
  const t0=performance.now();let n=0,acc="";
  try{
    const r=await fetch("v1/chat/completions",{method:"POST",
      headers:hdrs(),body:JSON.stringify(body),signal:controller.signal});
    if(!r.ok){el.textContent="[error "+r.status+"] "+await r.text();return;}
    const rd=r.body.getReader(),dec=new TextDecoder();let buf="";
    for(;;){
      const {done,value}=await rd.read();
      if(done)break;
      buf+=dec.decode(value,{stream:true});
      let i;
      while((i=buf.indexOf("\n"))>=0){
        const line=buf.slice(0,i).trim();buf=buf.slice(i+1);
        if(!line.startsWith("data:"))continue;
        const data=line.slice(5).trim();
        if(data==="[DONE]")continue;
        try{
          const j=JSON.parse(data);
          const d=j.choices&&j.choices[0]&&j.choices[0].delta;
          if(d&&d.content){acc+=d.content;n++;el.textContent=acc;
            log.scrollTop=log.scrollHeight;}
        }catch(e){}
      }
    }
  }catch(e){if(e.name!=="AbortError")el.textContent+="\n[error] "+e;}
  finally{
    controller=null;$("stop").disabled=true;$("send").disabled=false;
    $("regen").disabled=false;
    messages.push({role:"assistant",content:acc});
    const dt=(performance.now()-t0)/1e3;
    $("stats").textContent=n+" chunks in "+dt.toFixed(1)+"s ("+
      (n/Math.max(dt,1e-3)).toFixed(1)+" tok/s)";}}
$("f").addEventListener("submit",e=>{e.preventDefault();send();});
input.addEventListener("keydown",e=>{
  if(e.key==="Enter"&&!e.shiftKey){e.preventDefault();send();}});
$("stop").onclick=()=>{if(controller)controller.abort();};
$("clear").onclick=()=>{messages=[];log.innerHTML="";
  $("regen").disabled=true;};
$("regen").onclick=()=>{
  if(controller||!messages.length)return;
  while(messages.length&&messages[messages.length-1].role==="assistant")
    messages.pop();
  if(log.lastChild)log.removeChild(log.lastChild);
  complete();};
</script>
</body>
</html>
"""
